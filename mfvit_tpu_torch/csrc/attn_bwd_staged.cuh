// T5 staged_bwd: K5's function, the backward of x + proj(MHSA(LN(x))),
// with the harness's staged schedule, replacing tools/bench_bwd_staged.py
// ::staged_bwd (Pallas _staged_bwd_kernel :37). The TPU kernel is K5's
// _bwd_kernel line for line, except that it issues image b+1's forward
// recompute (LN, the qkv product, the softmax) before image b's gradient
// phase, so the vector unit's work of one image overlaps the matrix
// unit's products of the other, with two images' P live.
//
// The launch chain is K5's (fused_attn_bwd.cu) with its step 4, the
// attention core, replaced by the staged core below; the weight-gradient
// and LayerNorm reductions stay K5's split-K partials with their fixed
// reduction order.
//
// The staged core is K5's asynchronous core (attn_bwd_async.cuh: its ring,
// its stages and its task walk) with T5's unit walk and issue order:
// - Persistent blocks, one an SM, walk units of one head of cb images (a
//   block's pi-th pair: unit bid + (pi / cb) * grid, image pi % cb of that
//   unit's group; adjacent blocks take adjacent heads of one group).
// - A producer warp stages each pair's K and V rows, then its Q and dO
//   rows, by 16-byte cp.async into K5's mbarrier ring of S slots.
// - Consumer warps take K5's tasks (a pair's T query tiles, then its T key
//   tiles; warp w: tasks w, w + Wt, ...), with fragments by ldmatrix. At a
//   query tile a warp computes the scores and softmax (the recompute) and
//   defers the tile's gradient products (o = P V, dP, D_i, dS, dq, the
//   row statistics): it runs them after the scores and softmax of its next
//   query tile, so where its next tile lies in image b+1, that image's
//   recompute comes before image b's gradients. The deferred tile's fp32 P
//   (NKT x 4 registers a thread, 104 at N = 197) waits beside the next
//   tile's, as the TPU kernel holds two images' P. A key tile first runs
//   the deferred tile's products (it may wait on that tile's statistics).
// - Each slot, and each of S statistics buffers (pair pi uses pi % S), is
//   handed back by one arrival a task; a query tile arrives with its
//   deferred products, and so does its `ready` arrival (one a lane of each
//   query tile, counted by the pair's key tiles before they read the
//   statistics). Parity rule, re-derived for the lag: a warp waiting for
//   stage i still holds its deferred tile's stage, and stage i is filled
//   only after stage i - S was handed back, so that tile must lie within
//   S - 1 stages of i: at most (S - 1) * T warps take tasks (Wt; K5 allows
//   S * T). The same bound keeps each wait within one round of the last
//   (K5's rule (a)); K5's rule (b) on the statistics holds as in K5, the
//   deferred products coming after their stage is filled.
//
// Each warp runs attn_bwd.cuh's stages on its tiles unchanged (with
// ldmatrix, as K5), so o and dqkv, and with K5's GEMMs every output, equal
// K5's bit for bit.
//
// What bounds it on an H100: K5's work, about 209 GFLOP at ViT-S/16 B=256,
// of which the fp32 dWproj on the CUDA cores alone takes 0.22 ms; the core
// is bound as K5's is, by its CUDA-core work and each warp's latency, with
// fewer warps (two rows of P a thread). At head_dim 128 K5's ring has two
// slots up to N = 208 and one past it, where no tile can be deferred, so
// head_dim 128 takes N <= 208.
#pragma once

#include "attn_bwd_async.cuh"

namespace attn_bwd {
namespace staged {

// K5's ring (AsyncBwd's slots, statistics and barriers), with T5's warps
template <int DH, int NKT>
struct StagedBwd : AsyncBwd<DH, NKT> {
  // consumer warps, as measured best on the card (PERF.md): a thread holds
  // two rows of P (2 x NKT x 4 registers) besides the stages' fragments and
  // accumulators; 7 warps at 255 registers beat 11 at 168 and 15 at 128,
  // which spill more, and a trial that parked the deferred row in shared
  // memory beside a smaller ring
  static constexpr int W = 7;
  static constexpr int THREADS = (W + 1) * 32;
};

template <int DH, int NKT>
__global__ void __launch_bounds__(StagedBwd<DH, NKT>::THREADS, 1)
    staged_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                      float* __restrict__ o, bf16* __restrict__ dqkv, int B, int N, int heads,
                      float scale, int cb) {
  using C = StagedBwd<DH, NKT>;
  constexpr int S = C::S, W = C::W, NP = C::NP, LD = C::LD;
  static_assert(S >= 2, "a deferred tile holds its stage while the next is filled");
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
  const int units = B / cb * heads, bid = blockIdx.x, grid = gridDim.x;
  const int mine = units > bid ? ((units - 1 - bid) / grid + 1) * cb : 0;  // this block's pairs
  // the block's pi-th pair: its image and head
  auto image_of = [&](int pi) {
    return (size_t)((bid + pi / cb * grid) / heads * cb + pi % cb);
  };
  auto head_of = [&](int pi) { return (bid + pi / cb * grid) % heads * DH; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);       // one cp.async arrival a producer lane
      mbar_init(&empty[s], T);       // one arrival a task of the stage
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
      const size_t b = image_of(pi);
      const bf16* q = qkv + b * N * P3 + head_of(pi) + c;
      const bf16* src[2] = {q + D, q + 2 * D};  // phase A: K, V
      size_t pitch[2] = {P3, P3};
      if (i & 1) {  // phase B: Q, dO
        src[0] = q;
        src[1] = dout + b * N * D + head_of(pi) + c;
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

  auto head = [&](int pi) {
    const size_t b = image_of(pi);
    float* st = stats + pi % S * C::STATS;
    return Head{qkv + b * N * P3 + head_of(pi), dout + b * N * D + head_of(pi),
                dqkv + b * N * P3 + head_of(pi), o + b * N * D + head_of(pi),
                st, st + NP, st + 2 * NP, N, D, scale};
  };
  // the deferred query tile: its P and row statistics, its task index (-1
  // for none)
  float pd[NKT][4], dm0 = 0.f, dm1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  int dk = -1;
  // its gradient products; then its statistics and its stage are handed on
  auto finish = [&]() {
    const int pi = dk / (2 * T), slot = 2 * pi % S, q0 = 16 * (dk - pi * 2 * T);
    const bf16* T0 = ring + slot * 2 * C::PART;  // K rows, then V rows
    bwd_query_grads<DH, NKT, true>(head(pi), q0, T0, T0 + C::PART, pd, dm0, dm1, dl0, dl1);
    mbar_arrive(&ready[pi % S]);  // this lane's statistics are written
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this task is done with the slot
    dk = -1;
  };

  const int Wt = W < (S - 1) * T ? W : (S - 1) * T;
  for (int k = warp; warp < Wt && k < mine * 2 * T; k += Wt) {
    const int pi = k / (2 * T), r = k - pi * 2 * T, keys = r >= T;
    const int i = 2 * pi + keys, slot = i % S;
    const bf16* T0 = ring + slot * 2 * C::PART;  // phase A: K rows; phase B: Q rows
    const bf16* T1 = T0 + C::PART;               // phase A: V rows; phase B: dO rows
    if (keys && dk >= 0) finish();
    mbar_wait(&full[slot], (i / S) & 1);
    if (keys) {
      mbar_wait(&ready[pi % S], (pi / S) & 1);
      bwd_key_grads<DH, NKT, true>(head(pi), 16 * (r - T), T0, T1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      continue;
    }
    // the recompute of this query tile, then the last one's gradients
    float p[NKT][4], m0, m1, l0, l1;
    bwd_scores<DH, NKT, true>(head(pi), 16 * r, T0, p);
    bwd_softmax<NKT>(p, N, scale, m0, m1, l0, l1);
    if (dk >= 0) finish();
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[j][e] = p[j][e];
    dm0 = m0, dm1 = m1, dl0 = l0, dl1 = l1;
    dk = k;
  }
  if (dk >= 0) finish();
}

template <int DH, int NKT>
static int launch(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                  float scale, int cb, cudaStream_t s) {
  using C = StagedBwd<DH, NKT>;
  if constexpr (C::S < 2) {
    return (int)cudaErrorInvalidValue;  // one slot: no tile could wait for the next
  } else {
    auto kern = staged_bwd_kernel<DH, NKT>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    const int units = B / cb * heads;
    kern<<<units < sms ? units : sms, C::THREADS, C::SMEM, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<float*>(o),
        static_cast<bf16*>(dqkv), B, N, heads, scale, cb);
    return (int)cudaGetLastError();
  }
}

// K5's key-tile counts: 64, 128, 208 or 256 keys.
template <int DH>
static int launch_n(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                    int heads, float scale, int cb, cudaStream_t s) {
  if (N <= 64) return launch<DH, 8>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  if (N <= 128) return launch<DH, 16>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  if (N <= 208) return launch<DH, 26>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  return launch<DH, 32>(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
}

}  // namespace staged

// One translation unit per head_dim (attn_bwd_staged_dh{32,64,128}.cu),
// as K5's, so the instantiations compile in parallel.
int staged_dh32(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                float scale, int cb, cudaStream_t s);
int staged_dh64(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                float scale, int cb, cudaStream_t s);
int staged_dh128(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N, int heads,
                 float scale, int cb, cudaStream_t s);

// T5's staged core: K5's core's outputs, a block's units cb images of one
// head.
static int staged_core(const void* qkv, const void* dout, void* o, void* dqkv, int B, int N,
                       int heads, int dh, float scale, int cb, cudaStream_t s) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || cb <= 0 || B % cb != 0 ||
      (long long)B / cb * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return staged_dh32(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
    case 64: return staged_dh64(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
    case 128: return staged_dh128(qkv, dout, o, dqkv, B, N, heads, scale, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_bwd
