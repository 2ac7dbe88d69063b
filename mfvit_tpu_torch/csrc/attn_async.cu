// attn_async: the multi-head self-attention core of K1
// (mfvit_tpu/ops/fused_attn.py::fused_attention_block, _kernel :28) and of
// K15, between their qkv GEMM and their proj (fused_attn.cu,
// fused_block.cu):
//
//   qkv (B, N, 3D) bf16, columns [q | k | v] x head x dh -> o (B, N, D) in
//   OT: bf16 for K1 and K15, fp32 for K10 (fused_int8.cu), which quantizes
//   o per token
//
// It computes what attn_core.cuh's core computes (which the former chains
// and the schedule variants keep), with its rounding points and its order of every
// sum, so the two give the same bits: q scaled in fp32 and rounded to bf16;
// each score the fp32 sum over dh in ascending k16 steps (mma.sync
// m16n8k16); the row max over the valid keys, p = expf(s - max), each
// lane's row sum over the key tiles in ascending order, then the quad's
// xor-shuffle (attn_softmax's order); P rounded to bf16 from the score
// accumulators (attn_pack_p's packing), PV summed over the keys in
// ascending k16 steps, and 1/sum applied to the PV output, which is rounded
// once to bf16, or kept in fp32 (oacc * r, as attn_core<float> writes it).
// Keys past N get probability zero.
//
// What bounds it on an H100: at ViT-S/16 (B=256, N=197, 12 heads of 32) it
// reads qkv once and writes o once (155 MB, 0.046 ms at 3.35 TB/s) for 15.3
// GFLOP of q k^T and P V and 119 M exps (0.028 ms on the special function
// units). In practice the work on the CUDA cores that the rounding points
// ask for (an accurate expf, the masks, the row max and sum of every score)
// and the latency of each warp's chain of ldmatrix, mma.sync and exp: the
// more warps an SM holds, the more of it is hidden.
//
// The design:
// - Persistent blocks, one an SM, walk the (image, head) pairs; adjacent
//   blocks take adjacent heads of one image, so the rows of qkv they read
//   meet in L2.
// - A producer warp stages each pair's q, K and V rows (zeros past N, up to
//   the key tiles held) by 16-byte cp.async into a ring of two slots handed
//   over by mbarriers (one slot where two do not fit: head_dim 128), so the
//   next pair arrives under this pair's MMAs.
// - Consumer warps (AsyncCore::W, at most the tiles of S pairs) each take
//   one 16-row query tile at a time from the flattened sequence of the
//   block's pairs' tiles (warp w: tiles w, w + W, ...), so the tiles are
//   balanced across the warps over the whole walk (13 tiles a pair at N =
//   197 over 19 warps at head_dim 32), and a warp may start the next pair
//   while others finish this one. A slot is handed back when all its pair's
//   tiles are done (one arrival a tile).
// - Two passes over the keys, 16 at a time, so that no warp holds a row of
//   scores: the row max from the scores, then the same scores again (the
//   same sums, so the same bits), p, the row sums and P V at once. The
//   second q k^T costs less than the warps that held scores would cost
//   (a row of scores in registers, as attn_core.cuh holds it, leaves room
//   for 11 consumer warps: 0.220 ms at ViT-S B=256 against 0.188 for two
//   passes at 19, PERF.md). Only the last group below N needs the key
//   mask; groups past N are skipped (p = 0 adds nothing to any sum).
// - Fragments by ldmatrix from the row-major slots: q's A fragments, K's B
//   fragments, and V's by ldmatrix.trans (no transposed copy of V).
#include "attn_async.cuh"
#include "attn_core.cuh"

namespace {

constexpr int SMEM_MAX = 232448;

template <int DH, int NKT>  // NKT: key tiles of 8 held (even), NKT * 8 >= N
struct AsyncCore {
  static constexpr int NK = NKT * 8;     // rows staged of each of q, K and V
  static constexpr int LD = DH + 8;      // bf16 pitch of a staged row
  static constexpr int PART = NK * LD;   // bf16 of q, K or V in a slot
  static constexpr int SLOT = 3 * PART;  // bf16 of a slot
  static constexpr int SLOT_BYTES = SLOT * 2;
  static constexpr int STAGES = 2 * SLOT_BYTES + 4 * 8 <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM = STAGES * SLOT_BYTES + 2 * STAGES * 8;
  // consumer warps and the unrolling of a pass over the key groups, as
  // measured best on the card (PERF.md): the registers come as
  // four sub-partitions of 16,384, each holding every fourth warp, so
  // blocks of 20 warps leave 96 registers a thread, of 16 128, of 12 168
  static constexpr int W = DH == 32 ? 19 : DH == 64 ? 15 : 11;
  static constexpr int U = DH == 32 ? NKT / 2 : 2;
  static constexpr int THREADS = (W + 1) * 32;
};

template <int DH, int NKT, typename OT>
__global__ void __launch_bounds__(AsyncCore<DH, NKT>::THREADS, 1)
    attn_async_kernel(const bf16* __restrict__ qkv, OT* __restrict__ o, int B, int N, int heads,
                      float scale) {
  using C = AsyncCore<DH, NKT>;
  constexpr int S = C::STAGES, W = C::W, U = C::U;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::SLOT_BYTES);  // [slot]
  uint64_t* empty = full + S;                                              // [slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = heads * DH;
  const int T = (N + 15) / 16;  // query tiles of a pair
  const int pairs = B * heads, bid = blockIdx.x, grid = gridDim.x;
  const int mine = pairs > bid ? (pairs - 1 - bid) / grid + 1 : 0;  // this block's pairs
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);  // one cp.async arrival a producer lane
      mbar_init(&empty[s], T);  // one arrival a query tile
    }
  }
  __syncthreads();

  if (warp == W) {  // the producer
    constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
    const int c = lane % CPR * 8;
    for (int pi = 0; pi < mine; ++pi) {
      const int pair = bid + pi * grid, slot = pi % S;
      if (pi >= S) mbar_wait(&empty[slot], (pi / S + 1) & 1);
      const bf16* src = qkv + (size_t)(pair / heads) * N * 3 * D + (pair % heads) * DH + c;
      bf16* dst = ring + slot * C::SLOT + c;
#pragma unroll
      for (int part = 0; part < 3; ++part)  // q, K, V
        for (int n = lane / CPR; n < C::NK; n += RPI)
          cp_async16_zfill(dst + part * C::PART + n * C::LD,
                           n < N ? src + (size_t)n * 3 * D + part * D : src, n < N);
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // A slot's wait tells its rounds apart by parity alone, so no warp may
  // step past more than S pairs at once (it would pass on a round before
  // the one it waits for): at most S * T warps take tiles.
  const int Wt = W < S * T ? W : S * T;
  const int g = lane >> 2, t4 = lane & 3;
  for (int k = warp; warp < Wt && k < mine * T; k += Wt) {
    const int pi = k / T, q0 = (k - pi * T) * 16;
    const int pair = bid + pi * grid, slot = pi % S;
    mbar_wait(&full[slot], (pi / S) & 1);
    const bf16* Qs = ring + slot * C::SLOT;
    const bf16* Ks = Qs + C::PART;
    const bf16* Vs = Ks + C::PART;

    // q's A fragments, rows q0 .. q0 + 15, scaled in fp32 and rounded
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      ldsm_x4(qa[ks], Qs + (q0 + (lane & 15)) * C::LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[ks][r]));
        qa[ks][r] = pack_bf16x2(f.x * scale, f.y * scale);
      }
    }

    float oacc[DH / 8][4];
    float l0, l1;
    // the scores of 16-key group kk: sc[e] holds 8-key tile 2 kk + e
    // (attn_scores' layout), each sum over dh in ascending k16 steps
    auto scores = [&](int kk, float (&sc)[2][4]) {
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[e][0] = sc[e][1] = sc[e][2] = sc[e][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (16 * kk + (lane >> 4) * 8 + (lane & 7)) * C::LD + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16_16816(sc[0], qa[ks], kb[0], kb[1]);
        mma_bf16_16816(sc[1], qa[ks], kb[2], kb[3]);
      }
    };
    // the groups of 16 keys below N; all but the last hold no key past N
    const int groups = (N + 15) / 16;
    // pass 1: the row max of rows g (m0) and g + 8 (m1) over the valid keys
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll U
    for (int kk = 0; kk < NKT / 2; ++kk) {
      if (kk >= groups) break;
      float sc[2][4];
      scores(kk, sc);
      if (kk < groups - 1 || 16 * groups == N) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m0 = fmaxf(m0, fmaxf(sc[e][0], sc[e][1]));
          m1 = fmaxf(m1, fmaxf(sc[e][2], sc[e][3]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (16 * kk + 8 * e + 2 * t4 + c < N) {
              m0 = fmaxf(m0, sc[e][c]);
              m1 = fmaxf(m1, sc[e][2 + c]);
            }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // pass 2: the scores again, p = exp(s - max) (0 past N), the lane's row
    // sums over the key tiles in ascending order, P rounded as attn_pack_p
    // packs it, and O += P V at once (V's B fragments by ldmatrix.trans),
    // each sum over the keys in ascending k16 steps
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
    l0 = 0.f;
    l1 = 0.f;
#pragma unroll U
    for (int kk = 0; kk < NKT / 2; ++kk) {
      if (kk >= groups) break;  // past N: p = 0, no term of any sum
      float sc[2][4];
      scores(kk, sc);
      if (kk < groups - 1 || 16 * groups == N) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[e][c] = expf(sc[e][c] - m0);
            sc[e][2 + c] = expf(sc[e][2 + c] - m1);
            l0 += sc[e][c];
            l1 += sc[e][2 + c];
          }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool valid = 16 * kk + 8 * e + 2 * t4 + c < N;
            sc[e][c] = valid ? expf(sc[e][c] - m0) : 0.f;
            sc[e][2 + c] = valid ? expf(sc[e][2 + c] - m1) : 0.f;
            l0 += sc[e][c];
            l1 += sc[e][2 + c];
          }
      }
      const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                              pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::LD + dp * 16 +
                          (lane >> 4) * 8);
        mma_bf16_16816(oacc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this tile is done with the slot

    // 1/sum on the PV output (rounded once in bf16), rows below N
    const float r0 = 1.0f / l0, r1 = 1.0f / l1;
    OT* orow = o + ((size_t)(pair / heads) * N + q0 + g) * D + (pair % heads) * DH + 2 * t4;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      if (q0 + g < N) store_pair(orow + 8 * d, oacc[d][0] * r0, oacc[d][1] * r0);
      if (q0 + g + 8 < N)
        store_pair(orow + (size_t)8 * D + 8 * d, oacc[d][2] * r1, oacc[d][3] * r1);
    }
  }
}

template <int DH, int NKT, typename OT>
int launch(const void* qkv, void* o, int B, int N, int heads, float scale, cudaStream_t s) {
  using C = AsyncCore<DH, NKT>;
  auto kern = attn_async_kernel<DH, NKT, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int pairs = B * heads;
  kern<<<pairs < sms ? pairs : sms, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<OT*>(o), B, N, heads, scale);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as attn_core's: 64, 128, 208
// or 256 keys.
template <int DH, typename OT>
int launch_n(const void* qkv, void* o, int B, int N, int heads, float scale, cudaStream_t s) {
  if (N <= 64) return launch<DH, 8, OT>(qkv, o, B, N, heads, scale, s);
  if (N <= 128) return launch<DH, 16, OT>(qkv, o, B, N, heads, scale, s);
  if (N <= 208) return launch<DH, 26, OT>(qkv, o, B, N, heads, scale, s);
  return launch<DH, 32, OT>(qkv, o, B, N, heads, scale, s);
}

}  // namespace

template <typename OT>
int attn_async(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
               cudaStream_t s) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || (long long)B * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_n<32, OT>(qkv, o, B, N, heads, scale, s);
    case 64: return launch_n<64, OT>(qkv, o, B, N, heads, scale, s);
    case 128: return launch_n<128, OT>(qkv, o, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template int attn_async<bf16>(const void*, void*, int, int, int, int, float, cudaStream_t);
template int attn_async<float>(const void*, void*, int, int, int, int, float, cudaStream_t);
