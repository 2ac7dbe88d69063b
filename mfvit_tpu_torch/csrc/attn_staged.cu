// T4 attn_staged: K1's function, x + proj(MHSA(LN(x))), with the harness's
// staged schedule, replacing tools/bench_pipelined.py::attn_staged (Pallas
// _attn_kernel_staged :118, pallas_call :179). The TPU kernel computes
// every score product of its cb images first, then the softmax of image
// b+1 before the PV and proj products of image b, so that the vector unit
// runs beside the matrix unit.
//
// K1's four launches on one stream (fused_attn.cu), through the caller's
// (M, 3D) bf16 qkv and (M, D) bf16 o scratch: block_tail.cuh's LN pass,
// the qkv GEMM with its bias on gemm_sm90.cuh's wgmma core, the staged core
// below, and the proj GEMM with its bias and the bf16 residual on the same
// core.
//
// The staged core is a sibling of K1's (attn_async.cu) and of T2's
// (attn_rolling.cu), in a unit of its own so that the three build in
// parallel and K1's stays as it is:
// - Persistent blocks, one an SM, walk units of one head of cb images (a
//   block's i-th image: unit bid + (i / cb) * grid, image i % cb of that
//   unit's group), as T2's (ops/attn_variants.py::unit_walk).
// - A producer warp stages each image's q, K and V rows (zeros past N) by
//   16-byte cp.async into a ring of two slots handed over by mbarriers, so
//   image b+1 arrives under image b's products. Where two slots of q, K and
//   V do not fit (head_dim 128, N up to 208) a slot holds K and V, and q's
//   A fragments come from device memory, as T2's.
// - The consumer warps form two groups of G that ping-pong over two named
//   barriers: a group waits on its own before its tensor-core phase, the P
//   V of each warp's last tile (1/sum on the output, its slot handed back)
//   then the q k^T of its next, and arrives on the other's after it; then
//   it takes the row max, the exps and the row sums of that next tile, and
//   packs its P, on the CUDA cores and SFUs while the other group's MMAs
//   run. So the softmax of a tile runs before the P V of the one before,
//   and at an image's edge image b+1's softmax before image b's last P V.
//   Round r of the flattened 16-row query tiles of the block's images
//   gives tile r * 2 Gt + g * Gt + j to warp j of group g.
// - With PASSES = 1 a tile's fp32 scores stay in registers from q k^T to
//   the exps (NKT x 4 a thread); with PASSES = 2 the tensor-core phase
//   takes only the row max, and the exps take the scores again (K1's two
//   passes, the same sums), which moves q k^T into the CUDA-core phase.
// - The parity rule of the ring, with the deferral: a slot is handed back
//   when all T tiles of its image have run their P V, and image i is staged
//   only after image i - 2 was handed back. A warp waits for image i inside
//   its group's turn, after its deferred P V; the P V that image i waits on
//   belongs to a tile at most 2 Gt - 1 tiles before its own, which must lie
//   in image i - 1 or i: at most Gt = min(G, (T + 1) / 2) warps a group take
//   tiles (T the tiles of an image). The same bound keeps every wait one
//   round from the last, as parity alone tells rounds apart.
// - Fragments by ldmatrix from the row-major slots (V's by
//   ldmatrix.trans).
//
// Every score, maximum, exp, sum and P V runs in the order and with the
// rounding points of K1's core (attn_async.cu's header), so T4 equals the
// K1 kernel bit for bit.
//
// What bounds it on an H100: K1's work, 74.8 GFLOP at ViT-S B=256 (0.076 ms
// at the bf16 peak); the core is bound as K1's is, by its CUDA-core work
// and the latency of each warp's chain, here with fewer warps (2 Gt) than
// K1's and a barrier between the groups' turns. The former design (two
// warpgroups on K1's former WMMA chain) stays in attn_staged_wmma.cu as the
// check-only mfv_attn_staged_wmma.
#include "attn_core.cuh"
#include "block_tail.cuh"

namespace {

constexpr int SMEM_MAX = 232448;

template <int DH, int NKT>  // NKT: key tiles of 8 held (even), NKT * 8 >= N
struct StagedCore {
  static constexpr int NK = NKT * 8;  // rows staged of each part
  static constexpr int LD = DH + 8;   // bf16 pitch of a staged row
  static constexpr int PART = NK * LD;
  // q beside K and V where two such slots fit
  static constexpr bool QS = 2 * 3 * PART * 2 + 4 * 8 <= SMEM_MAX;
  static constexpr int PARTS = QS ? 3 : 2;
  static constexpr int SLOT = PARTS * PART;  // bf16 of a slot
  static constexpr int SLOT_BYTES = SLOT * 2;
  static constexpr int SMEM = 2 * SLOT_BYTES + 4 * 8;
  // warps a group and passes over the keys, as measured best on the card
  // (tools/core_trials.py, PERF.md): two passes at 7 warps a group (136
  // registers a thread) beat one pass (a row of fp32 scores held) at 4-7
  // and two at 6; at N = 197 the bound below lets 7 a group take tiles
  static constexpr int G = 7;
  static constexpr int PASSES = 2;
  static constexpr int THREADS = (2 * G + 1) * 32;
};

// a group's turn: wait on its own barrier (n threads: both groups' takers)
__device__ __forceinline__ void turn_wait(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// hand the turn to the other group
__device__ __forceinline__ void turn_pass(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int DH, int NKT>
__global__ void __launch_bounds__(StagedCore<DH, NKT>::THREADS, 1)
    attn_staged_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int B, int N,
                       int heads, float scale, int cb) {
  using C = StagedCore<DH, NKT>;
  constexpr int G = C::G, KG = NKT / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * C::SLOT_BYTES);  // [slot]
  uint64_t* empty = full + 2;                                             // [slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = heads * DH;
  const size_t P3 = (size_t)3 * D;
  const int T = (N + 15) / 16;  // query tiles of an image
  const int units = B / cb * heads, bid = blockIdx.x, grid = gridDim.x;
  const int mine = units > bid ? ((units - 1 - bid) / grid + 1) * cb : 0;  // this block's images
  // the block's i-th image and its head
  auto image_of = [&](int i) {
    return (size_t)((bid + i / cb * grid) / heads * cb + i % cb);
  };
  auto head_of = [&](int i) { return (bid + i / cb * grid) % heads * DH; };
  // their q columns in qkv (K at +D, V at +2D)
  auto q_of = [&](int i) { return qkv + image_of(i) * N * P3 + head_of(i); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 32);  // one cp.async arrival a producer lane
      mbar_init(&empty[s], T);  // one arrival a query tile, after its P V
    }
  }
  __syncthreads();

  if (warp == 2 * G) {  // the producer
    constexpr int CPR = DH / 8, RPI = 32 / CPR;  // 16-byte chunks a row, rows an iteration
    const int c = lane % CPR * 8;
    for (int i = 0; i < mine; ++i) {
      const int slot = i & 1;
      if (i >= 2) mbar_wait(&empty[slot], (i / 2 + 1) & 1);
      const bf16* src = q_of(i) + c + (C::QS ? 0 : D);
      bf16* dst = ring + slot * C::SLOT + c;
#pragma unroll
      for (int part = 0; part < C::PARTS; ++part)  // [q,] K, V
        for (int n = lane / CPR; n < C::NK; n += RPI)
          cp_async16_zfill(dst + part * C::PART + n * C::LD,
                           n < N ? src + (size_t)n * P3 + part * D : src, n < N);
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // group grp's warp j; the warps past Gt in each group take no tile
  const int grp = warp / G, j = warp % G;
  const int Gt = G < (T + 1) / 2 ? G : (T + 1) / 2;
  if (j >= Gt) return;
  const int nthr = 64 * Gt;  // the threads that meet at a turn's barrier
  const int total = mine * T, rounds = (total + 2 * Gt - 1) / (2 * Gt);
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = (N + 15) / 16;  // groups of 16 keys below N; the last may pass N
  // the deferred tile: its P, packed, its row sums and where it lies
  uint32_t pd[KG][4];
  float dl0 = 0.f, dl1 = 0.f;
  int dk = -1;  // its index in the walk, -1 for none
  // P V of the deferred tile, 1/sum on the output (rounded once to bf16),
  // and its slot handed back
  auto finish = [&]() {
    const int i = dk / T, q0 = (dk - i * T) * 16, slot = i & 1;
    const bf16* Vs = ring + slot * C::SLOT + (C::PARTS - 1) * C::PART;
    float oacc[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= groups) break;  // past N: p = 0, no term of any sum
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::LD + dp * 16 +
                          (lane >> 4) * 8);
        mma_bf16_16816(oacc[2 * dp], pd[kk], vb[0], vb[1]);
        mma_bf16_16816(oacc[2 * dp + 1], pd[kk], vb[2], vb[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this tile is done with the slot
    const float r0 = 1.0f / dl0, r1 = 1.0f / dl1;
    bf16* orow = o + (image_of(i) * N + q0 + g) * D + head_of(i) + 2 * t4;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      if (q0 + g < N) store_pair(orow + 8 * d, oacc[d][0] * r0, oacc[d][1] * r0);
      if (q0 + g + 8 < N)
        store_pair(orow + (size_t)8 * D + 8 * d, oacc[d][2] * r1, oacc[d][3] * r1);
    }
    dk = -1;
  };

  if (grp == 1) turn_pass(PP_BAR, nthr);  // group 0 takes the first turn
  // Every taker runs rounds + 1 turns (one without a tile passes the turn
  // on), so every wait meets one arrival; group 1's last turn passes to no
  // one.
  for (int r = 0; r <= rounds; ++r) {
    turn_wait(PP_BAR + grp, nthr);
    if (dk >= 0) finish();
    const int k = r * 2 * Gt + grp * Gt + j;
    const bool has = r < rounds && k < total;
    const int i = k / T, q0 = (k - i * T) * 16, slot = i & 1;
    const bf16* Ks = ring + slot * C::SLOT + (C::QS ? C::PART : 0);
    uint32_t qa[DH / 16][4];
    // the scores of 16-key group kk: sc[e] holds 8-key tile 2 kk + e, each
    // sum over dh in ascending k16 steps
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
    float held[C::PASSES == 1 ? KG : 1][2][4];
    float m0 = -INFINITY, m1 = -INFINITY;
    if (has) {
      mbar_wait(&full[slot], (i / 2) & 1);
      // q's A fragments, rows q0 .. q0 + 15, scaled in fp32 and rounded
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        if constexpr (C::QS) {
          ldsm_x4(qa[ks], ring + slot * C::SLOT + (q0 + (lane & 15)) * C::LD + ks * 16 +
                              (lane >> 4) * 8);
        } else {  // the fragment layout ldmatrix gives, from device memory (zeros past N)
          const bf16* qg = q_of(i);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int row = q0 + g + (rr & 1) * 8, col = ks * 16 + 2 * t4 + (rr >> 1) * 8;
            qa[ks][rr] = row < N ? *reinterpret_cast<const uint32_t*>(qg + (size_t)row * P3 + col)
                                 : 0u;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float2 f =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[ks][rr]));
          qa[ks][rr] = pack_bf16x2(f.x * scale, f.y * scale);
        }
      }
      // q k^T, and the row max of rows g (m0) and g + 8 (m1) over the
      // valid keys
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        if (kk >= groups) break;
        float(&sc)[2][4] = held[C::PASSES == 1 ? kk : 0];
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
    }
    if (!(grp == 1 && r == rounds)) turn_pass(PP_BAR + (grp ^ 1), nthr);
    if (!has) continue;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // p = exp(s - max) (0 past N), the lane's row sums over the key tiles in
    // ascending order, P rounded as attn_pack_p packs it; the tile waits
    // for its P V in the group's next turn
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (kk >= groups) break;
      float(&sc)[2][4] = held[C::PASSES == 1 ? kk : 0];
      if (C::PASSES == 2) scores(kk, sc);
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
      pd[kk][0] = pack_bf16x2(sc[0][0], sc[0][1]);
      pd[kk][1] = pack_bf16x2(sc[0][2], sc[0][3]);
      pd[kk][2] = pack_bf16x2(sc[1][0], sc[1][1]);
      pd[kk][3] = pack_bf16x2(sc[1][2], sc[1][3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    dl0 = l0;
    dl1 = l1;
    dk = k;
  }
}

template <int DH, int NKT>
int launch(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
           cudaStream_t s) {
  using C = StagedCore<DH, NKT>;
  auto kern = attn_staged_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int units = B / cb * heads;
  kern<<<units < sms ? units : sms, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(o), B, N, heads, scale, cb);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as K1's core: 64, 128, 208 or
// 256 keys; two slots of K and V pass the shared memory at head_dim 128
// past 208.
template <int DH>
int launch_n(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
             cudaStream_t s) {
  if (N <= 64) return launch<DH, 8>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 128) return launch<DH, 16>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 208) return launch<DH, 26>(qkv, o, B, N, heads, scale, cb, s);
  if constexpr (DH < 128) return launch<DH, 32>(qkv, o, B, N, heads, scale, cb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

MFV_API int mfv_attn_staged(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                            const void* bqkv, const void* wproj, const void* bproj, void* qkv,
                            void* o, void* out, int B, int N, int D, int heads, int cb,
                            float scale, void* stream) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || D % heads != 0 || cb <= 0 || B % cb != 0 ||
      (long long)B / cb * heads > 0x7fffffffLL || !blk::ln1_takes(D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, dh = D / heads;
  if (dh != 32 && dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  if (int e = blk::launch_ln1(x, ln_s, ln_b, o, M, D, s)) return e;
  if (int e = sm90::gemm<EPI_BIAS>(o, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)) return e;
  int e = dh == 32   ? launch_n<32>(qkv, o, B, N, heads, scale, cb, s)
          : dh == 64 ? launch_n<64>(qkv, o, B, N, heads, scale, cb, s)
                     : launch_n<128>(qkv, o, B, N, heads, scale, cb, s);
  if (e) return e;
  return sm90::gemm<EPI_BIAS_RESID>(o, wproj, bproj, x, out, M, D, D, s);
}
