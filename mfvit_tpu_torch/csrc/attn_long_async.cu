// attn_long_async: the multi-head self-attention core of K9
// (mfvit_tpu/ops/fused_attn.py::fused_attention_block_large, Pallas
// _kernel_qblocked :244; fused_attn_large.cu) for any sequence length:
//
//   qkv (B, N, 3D) bf16, columns [q | k | v] x head x dh -> o (B, N, D) in
//   OT: bf16 for K9, fp32 for K10 past NMAX tokens (fused_int8.cu)
//
// It computes what attn_long.cuh's core computes (which the chains K9 and
// K10 ran before keep), with its rounding points and the
// order of every sum, so the two give the same bits: q scaled in fp32 and
// rounded to bf16; each score the fp32 sum over dh in ascending k16 steps
// (mma.sync m16n8k16); two passes over the keys, not an online softmax:
// the row max over the valid keys first, then p = expf(s - max), so P is
// rounded to bf16 against the row's final max, where the TPU kernel rounds
// it; each lane's row sum over the key tiles in ascending order, then the
// quad's xor-shuffle; PV summed over the keys in ascending k16 steps; 1/sum
// applied once to the PV output, which is rounded once to bf16 or kept in
// fp32 (oacc * r, as attn_long<float> writes it). Keys past N get
// probability zero; groups of 16 keys wholly past N are skipped (p = 0
// adds nothing to any sum, as attn_async.cu's do).
//
// What bounds it on an H100: at vit_small@384 (B=64, N=577, 12 heads of
// 32) 49 GFLOP of q k^T (twice) and P V and 256 M exps (0.061 ms on the
// special function units) against 85 MB of qkv and o: in practice, as K1's
// core (attn_async.cu), the CUDA-core work the rounding points ask for (an
// accurate expf, the masks, the row max and sum of every score) and the
// latency of each warp's chain of ldmatrix, mma.sync and exp.
//
// The design (attn_async.cu's idiom, with the keys streamed in tiles: one
// head's K and V do not fit a block's shared memory at N = 1025, head_dim
// 64, or at head_dim 128, N = 577):
// - A unit is one (image, head) and LONG_W query tiles of 16 rows;
//   persistent blocks (LongAsync::BLOCKS an SM) walk the units in order,
//   so blocks at work at once take neighbouring query tiles of one head
//   and read its key tiles from L2.
// - A producer warp streams each unit as a sequence of stages of
//   LONG_KEYS rows by 16-byte cp.async (zeros past N) into a ring of
//   LONG_STAGES stages handed over by mbarriers: the unit's q rows, its K
//   tiles (pass 1), then its K and V tiles in turn (pass 2). The ring runs
//   on across units, so the next unit's q and keys arrive under this one's
//   last MMAs.
// - Each of LONG_W consumer warps holds one 16-row query tile and takes
//   every stage in order (a warp whose tile lies past N only hands them
//   back); a stage is handed back when every consumer warp is done with
//   it (one arrival a warp).
// - Fragments by ldmatrix from the row-major stages: q's A fragments, K's
//   B fragments, and V's by ldmatrix.trans (no transposed copy of V). Only
//   the last key tile can hold keys past N, and only its last group
//   takes the key mask.
#include "attn_core.cuh"
#include "attn_long_async.cuh"

namespace {

template <int DH>
struct LongAsync {
  static constexpr int LD = DH + 8;                // bf16 pitch of a staged row
  static constexpr int STAGE = LONG_KEYS * LD;     // bf16 of a stage
  static constexpr int STAGE_BYTES = STAGE * 2;
  static constexpr int QROWS = LONG_W * 16;        // query rows a unit
  static constexpr int QS = (QROWS + LONG_KEYS - 1) / LONG_KEYS;  // stages of q
  static constexpr int SMEM = LONG_STAGES * STAGE_BYTES + 2 * LONG_STAGES * 8;
  // two blocks an SM where their registers fit (112 a thread), else one
  static constexpr int BLOCKS = DH == 128 ? 1 : 2;
  static constexpr int THREADS = (LONG_W + 1) * 32;
};

// a place in the ring: stage s and the parity of its current round
struct Pos {
  int s = 0, ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == LONG_STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
};

template <int DH, typename OT>
__global__ void __launch_bounds__(LongAsync<DH>::THREADS, LongAsync<DH>::BLOCKS)
    attn_long_async_kernel(const bf16* __restrict__ qkv, OT* __restrict__ o, int B, int N,
                           int heads, float scale) {
  using C = LongAsync<DH>;
  constexpr int S = LONG_STAGES, W = LONG_W;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::STAGE_BYTES);  // [stage]
  uint64_t* empty = full + S;                                               // [stage]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = heads * DH;
  const int nt = (N + LONG_KEYS - 1) / LONG_KEYS;  // key tiles
  const int qblk = (N + C::QROWS - 1) / C::QROWS;  // units of an (image, head)
  const long long units = (long long)B * heads * qblk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);  // one cp.async arrival a producer lane
      mbar_init(&empty[s], W);  // one arrival a consumer warp
    }
  }
  __syncthreads();

  if (warp == W) {  // the producer
    constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
    const int c = lane % CPR * 8;
    Pos p;
    // rows r0 .. r0 + LONG_KEYS - 1 of one part (q, K or V; `src` its
    // column c of token 0) into the next stage, zeros past N
    auto put = [&](const bf16* src, int r0) {
      mbar_wait(&empty[p.s], p.ph ^ 1);
      bf16* dst = ring + p.s * C::STAGE + c;
      for (int n = lane / CPR; n < LONG_KEYS; n += RPI) {
        const int row = r0 + n;
        cp_async16_zfill(dst + n * C::LD, row < N ? src + (size_t)row * 3 * D : src, row < N);
      }
      cp_async_arrive(&full[p.s]);
      p.next();
    };
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int pair = (int)(u / qblk), qb = (int)(u % qblk);
      const bf16* src = qkv + (size_t)(pair / heads) * N * 3 * D + (pair % heads) * DH + c;
      for (int i = 0; i < C::QS; ++i) put(src, qb * C::QROWS + i * LONG_KEYS);
      for (int t = 0; t < nt; ++t) put(src + D, t * LONG_KEYS);
      for (int t = 0; t < nt; ++t) {
        put(src + D, t * LONG_KEYS);
        put(src + 2 * D, t * LONG_KEYS);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  Pos p;
  auto acquire = [&](const Pos& at) {
    mbar_wait(&full[at.s], at.ph);
    return static_cast<const bf16*>(ring + at.s * C::STAGE);
  };
  auto release = [&](const Pos& at) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[at.s]);
  };
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int pair = (int)(u / qblk), qb = (int)(u % qblk);
    const int q0 = qb * C::QROWS + warp * 16;  // this warp's query tile
    const bool active = q0 < N;

    // q's A fragments, rows q0 .. q0 + 15, scaled in fp32 and rounded
    uint32_t qa[DH / 16][4];
    for (int i = 0; i < C::QS; ++i) {
      const bf16* st = acquire(p);
      if (active && warp * 16 / LONG_KEYS == i) {
        const bf16* Qs = st + (warp * 16 % LONG_KEYS) * C::LD;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          ldsm_x4(qa[ks], Qs + (lane & 15) * C::LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[ks][r]));
            qa[ks][r] = pack_bf16x2(f.x * scale, f.y * scale);
          }
        }
      }
      release(p);
      p.next();
    }

    // the scores of 16-key group kk of the tile at Ks: sc[e] holds 8-key
    // tile 2 kk + e (attn_long.cuh's layout), each sum over dh in
    // ascending k16 steps
    auto scores = [&](const bf16* Ks, int kk, float (&sc)[2][4]) {
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

    // pass 1: the row max of rows g (m0) and g + 8 (m1) over the valid keys
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int t = 0; t < nt; ++t) {
      const bf16* Ks = acquire(p);
      const int k0 = t * LONG_KEYS;
      if (active) {
        if (k0 + LONG_KEYS <= N) {  // a whole tile: no mask
#pragma unroll
          for (int kk = 0; kk < LONG_KEYS / 16; ++kk) {
            float sc[2][4];
            scores(Ks, kk, sc);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              m0 = fmaxf(m0, fmaxf(sc[e][0], sc[e][1]));
              m1 = fmaxf(m1, fmaxf(sc[e][2], sc[e][3]));
            }
          }
        } else {  // the last tile: its groups below N, the key mask
          const int groups = (N - k0 + 15) / 16;
          for (int kk = 0; kk < groups; ++kk) {
            float sc[2][4];
            scores(Ks, kk, sc);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                if (k0 + 16 * kk + 8 * e + 2 * t4 + cc < N) {
                  m0 = fmaxf(m0, sc[e][cc]);
                  m1 = fmaxf(m1, sc[e][2 + cc]);
                }
          }
        }
      }
      release(p);
      p.next();
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }

    // pass 2: the scores again, p = exp(s - max) (0 past N), the lane's row
    // sums over the key tiles in ascending order, P rounded as attn_long.cuh
    // packs it, and O += P V at once, each sum over the keys in ascending
    // k16 steps
    float oacc[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    auto group = [&](const bf16* Ks, const bf16* Vs, int kk, bool mask, int k0) {
      float sc[2][4];
      scores(Ks, kk, sc);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const bool valid = !mask || k0 + 16 * kk + 8 * e + 2 * t4 + cc < N;
          sc[e][cc] = valid ? expf(sc[e][cc] - m0) : 0.f;
          sc[e][2 + cc] = valid ? expf(sc[e][2 + cc] - m1) : 0.f;
          l0 += sc[e][cc];
          l1 += sc[e][2 + cc];
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
    };
    for (int t = 0; t < nt; ++t) {
      const Pos pk = p;
      p.next();
      const bf16* Ks = acquire(pk);
      const bf16* Vs = acquire(p);
      const int k0 = t * LONG_KEYS;
      if (active) {
        if (k0 + LONG_KEYS <= N) {
#pragma unroll
          for (int kk = 0; kk < LONG_KEYS / 16; ++kk) group(Ks, Vs, kk, false, k0);
        } else {
          const int groups = (N - k0 + 15) / 16;
          for (int kk = 0; kk < groups - 1; ++kk) group(Ks, Vs, kk, false, k0);
          group(Ks, Vs, groups - 1, true, k0);
        }
      }
      release(pk);
      release(p);
      p.next();
    }
    if (!active) continue;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

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

template <int DH, typename OT>
int launch(const void* qkv, void* o, int B, int N, int heads, float scale, cudaStream_t s) {
  using C = LongAsync<DH>;
  auto kern = attn_long_async_kernel<DH, OT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long units = (long long)B * heads * ((N + C::QROWS - 1) / C::QROWS);
  const long long grid = (long long)C::BLOCKS * sms;
  kern<<<(int)(units < grid ? units : grid), C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<OT*>(o), B, N, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

template <typename OT>
int attn_long_async(const void* qkv, void* o, int B, int N, int heads, int dh, float scale,
                    cudaStream_t s) {
  if (B <= 0 || N <= 0 || heads <= 0 || (long long)B * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch<32, OT>(qkv, o, B, N, heads, scale, s);
    case 64: return launch<64, OT>(qkv, o, B, N, heads, scale, s);
    case 128: return launch<128, OT>(qkv, o, B, N, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template int attn_long_async<bf16>(const void*, void*, int, int, int, int, float, cudaStream_t);
template int attn_long_async<float>(const void*, void*, int, int, int, int, float, cudaStream_t);
