// T1 attn_pairs: K1's function, x + proj(MHSA(LN(x))), with the harness's
// pair-batched schedule, replacing tools/bench_attn_pairs.py::attn_pairs
// (Pallas _attn_pairs_kernel :37, pallas_call :104). The TPU kernel stacks
// the score and P V dot_generals of two images into one (2H, dh, N) batch,
// so each matrix-unit dispatch carries more independent products of the
// small dh = 32 contractions, and issues pair i+1's softmax before pair i's
// P V.
//
// K1's four launches on one stream (fused_attn.cu), through the caller's
// (M, 3D) bf16 qkv and (M, D) bf16 o scratch: block_tail.cuh's LN pass,
// the qkv GEMM with its bias on gemm_sm90.cuh's wgmma core, the pair core
// below, and the proj GEMM with its bias and the bf16 residual on the same
// core.
//
// The pair core is a sibling of K1's (attn_async.cu) and of T2's and T4's
// (attn_rolling.cu, attn_staged.cu), built on the per-tile pieces it
// shares with T2's core (attn_tile.cuh), in a unit of its own so that they
// build in parallel:
// - Persistent blocks, one an SM, walk units of one head of cb images (a
//   block's i-th image: unit bid + (i / cb) * grid, image i % cb of that
//   unit's group; ops/attn_variants.py::unit_walk), a pair at a time:
//   pair p is the block's images 2p and 2p + 1 (cb is even, so a pair
//   never straddles two units).
// - A producer warp stages one head of both images of a pair into one ring
//   slot by 16-byte cp.async (zeros past N); an mbarrier hands the slot
//   over, one "full" wait and one "empty" handback a pair. The slots
//   (ops/attn_variants.py::pairs_plan): two of q, K and V where they fit
//   (head_dim 32 to 208 keys: 2 x 99,840 bytes), else two of K and V
//   (head_dim 32 at 256 keys), else one of q, K and V (head_dim 64 past 128
//   keys: 179,712 bytes at 208; head_dim 128 at 128), else one of K and V
//   (head_dim 128 at 208 keys: 226,304); where q is not staged its A
//   fragments come from device memory.
// - Consumer warps take the flattened tiles of the block's pairs (warp w:
//   tiles w, w + Wt, ...). With NI = 2 a tile is the same 16 query rows of
//   both images of the pair (2 T image tiles a pair in T pair tiles, T =
//   ceil(N / 16)), and the warp issues image a's and image b's q k^T
//   mma.sync for each k16 step into two independent accumulator chains,
//   interleaved, and so the two P V chains: the GPU form of the batch's
//   independent products. With NI = 1 a tile is one image's 16 rows (2 T
//   a pair), T2's per-warp chain within pair slots. The card chose NI = 1
//   (PairCore's note): a deferred pair tile and the next one hold 2 x 2 x
//   NKT / 2 x 4 packed P registers, which spill.
// - The TPU's order: with DEFER a warp computes its next tile's scores and
//   softmax before its last tile's P V, whose P waits packed as bf16 A
//   fragments (NI x NKT / 2 x 4 registers); so at a pair's edge pair p+1's
//   scores and softmax come before pair p's last P V. A slot is handed back
//   after each of its image tiles has run its P V (one arrival an image
//   tile).
// - The parity/takers rule: pair p is staged only after pair p - S was
//   handed back. With two slots a warp that waits for pair p still holds a
//   deferred tile, which must lie in pair p - 1 or p, so at most TP warps
//   take tiles (Wt = min(W, TP), TP the tiles of a pair). The same bound
//   keeps every wait one round from the last, as parity alone tells rounds
//   apart.
// - A one-slot ring: the deferred tile of pair p - 1 would hold the only
//   slot that pair p needs, so a warp finishes its deferred P V before it
//   waits for a new pair (the TPU's order then holds within a pair only).
//   Splitting the slot into K and V halves with barriers of their own
//   would keep the order across the boundary, but the next pair's V still
//   waits for the last P V, and at 208 keys no second K or V part fits
//   beside the slot at head_dim 64 or 128.
//
// Every score, maximum, exp, sum and P V runs in the order and with the
// rounding points of K1's core (attn_tile.cuh), so T1 equals the K1 kernel
// bit for bit.
//
// What bounds it on an H100: K1's work, 74.8 GFLOP at ViT-S B=256 (0.076 ms
// at the bf16 peak); the core is bound as K1's is, by its CUDA-core work
// and the latency of each warp's chain, with fewer warps than K1's (TP at
// most) and the pair grain: units = B / cb x heads over 132 SMs. The former
// design (K1's former WMMA chain, K and a transposed V in shared memory,
// block-wide barriers) stays in attn_pairs_wmma.cu as the check-only
// mfv_attn_pairs_wmma.
#include "attn_tile.cuh"
#include "block_tail.cuh"

namespace {

constexpr int SMEM_MAX = 232448;

// bytes of a ring of `slots` pair slots, `parts` parts an image of `part`
// bf16 each, and its full and empty barriers
constexpr int pair_ring(int part, int slots, int parts) {
  return slots * 2 * parts * part * 2 + 2 * slots * 8;
}

template <int DH, int NKT>  // NKT: key tiles of 8 held (even), NKT * 8 >= N
struct PairCore {
  static constexpr int NK = NKT * 8;    // rows staged of each part
  static constexpr int LD = DH + 8;     // bf16 pitch of a staged row
  static constexpr int PART = NK * LD;  // bf16 of one image's q, K or V
  // two slots of q, K and V where they fit, else two of K and V, else one
  // of q, K and V, else one of K and V
  static constexpr int S =
      pair_ring(PART, 2, 3) <= SMEM_MAX || pair_ring(PART, 2, 2) <= SMEM_MAX ? 2 : 1;
  static constexpr bool QS = pair_ring(PART, S, 3) <= SMEM_MAX;
  static constexpr int PARTS = QS ? 3 : 2;
  static constexpr int IMAGE = PARTS * PART;  // bf16 of one image in a slot
  static constexpr int SLOT = 2 * IMAGE;      // bf16 of a pair slot
  static constexpr int SLOT_BYTES = SLOT * 2;
  static constexpr int SMEM = pair_ring(PART, S, PARTS);
  // consumer warps, passes over the keys, images a tile (2: pair tiles,
  // the two images' chains interleaved; 1: image tiles) and whether a
  // tile's P V waits past the next tile's softmax, as measured best on the
  // card (tools/core_trials.py --set t1, PERF.md): image tiles deferred at
  // 11 warps, two passes (160 registers at head_dim 32, N = 197) beat pair
  // tiles, whose deferred and next P (2 x 2 x 52 registers) spill at every
  // warp count (7 warps, 255 registers, least: 1.2x slower), pair tiles
  // undeferred (1.1x) and one pass (a pair's rows of scores held, 2.6x); at
  // head_dim 128 two passes at 7 warps (230 registers) beat one
  static constexpr int W = DH == 128 ? 7 : 11;
  static constexpr int PASSES = 2;
  static constexpr int NI = 1;
  static constexpr bool DEFER = true;
  static constexpr int THREADS = (W + 1) * 32;
};

template <int DH, int NKT>
__global__ void __launch_bounds__(PairCore<DH, NKT>::THREADS, 1)
    attn_pairs_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int B, int N,
                      int heads, float scale, int cb) {
  using C = PairCore<DH, NKT>;
  using TL = tile::Tile<DH, NKT, C::NI, C::PASSES>;
  constexpr int S = C::S, W = C::W, NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::SLOT_BYTES);  // [slot]
  uint64_t* empty = full + S;                                             // [slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = heads * DH;
  const size_t P3 = (size_t)3 * D;
  const int T = (N + 15) / 16;  // query tiles of an image
  const int TP = 2 * T / NI;    // tiles of a pair
  const int units = B / cb * heads, bid = blockIdx.x, grid = gridDim.x;
  const int mine = units > bid ? ((units - 1 - bid) / grid + 1) * (cb / 2) : 0;  // this block's pairs
  // the block's i-th image and its head; pair p holds images 2p and 2p + 1
  auto image_of = [&](int i) {
    return (size_t)((bid + i / cb * grid) / heads * cb + i % cb);
  };
  auto head_of = [&](int i) { return (bid + i / cb * grid) % heads * DH; };
  // their q columns in qkv (K at +D, V at +2D)
  auto q_of = [&](int i) { return qkv + image_of(i) * N * P3 + head_of(i); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);      // one cp.async arrival a producer lane
      mbar_init(&empty[s], 2 * T);  // one arrival an image tile, after its P V
    }
  }
  __syncthreads();

  if (warp == W) {  // the producer: both images of pair p into slot p % S
    for (int p = 0; p < mine; ++p) {
      const int slot = p % S;
      if (p >= S) mbar_wait(&empty[slot], (p / S + 1) & 1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tile::stage_image<DH, NKT, C::PARTS>(ring + slot * C::SLOT + j * C::IMAGE,
                                             q_of(2 * p + j) + (C::QS ? 0 : D), N, P3, D, lane);
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int Wt = W < TP ? W : TP;
  const int g = lane >> 2, t4 = lane & 3;
  // tile k: pair k / TP, its first image in the block's walk and its rows
  auto first_image = [&](int k) {
    const int p = k / TP;
    return 2 * p + (NI == 2 ? 0 : (k - p * TP) / T);
  };
  auto rows = [&](int k) { return (k % TP % T) * 16; };
  // the deferred tile: its P, packed, its row sums and its index in the
  // walk, -1 for none
  typename TL::P pd;
  float dl0[NI], dl1[NI];
  int dk = -1;
  // P V of the deferred tile, its image tiles handed back to the slot, 1/sum
  // on the outputs (rounded once to bf16)
  auto finish = [&]() {
    const int p = dk / TP, i0 = first_image(dk), q0 = rows(dk), slot = p % S;
    const bf16* Vs[NI];
#pragma unroll
    for (int n = 0; n < NI; ++n)
      Vs[n] = ring + slot * C::SLOT + (i0 - 2 * p + n) * C::IMAGE + (C::PARTS - 1) * C::PART;
    typename TL::O oacc;
    TL::pv(oacc, pd, Vs, N, lane);
    __syncwarp();
    if (lane == 0) {  // its image tiles are done with the slot
      for (int n = 0; n < NI; ++n) mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int n = 0; n < NI; ++n)
      TL::store(oacc[n], dl0[n], dl1[n],
                o + (image_of(i0 + n) * N + q0 + g) * D + head_of(i0 + n) + 2 * t4, q0, N, D,
                lane);
    dk = -1;
  };

  for (int k = warp; warp < Wt && k < mine * TP; k += Wt) {
    const int p = k / TP, i0 = first_image(k), q0 = rows(k), slot = p % S;
    if constexpr (S == 1) {  // the deferred tile of the last pair holds the slot
      if (dk >= 0 && dk / TP != p) finish();
    }
    mbar_wait(&full[slot], (p / S) & 1);
    const bf16* img = ring + slot * C::SLOT + (i0 - 2 * p) * C::IMAGE;
    typename TL::Q qa;
    const bf16* Ks[NI];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      tile::load_q<DH, C::QS>(qa[n], img + n * C::IMAGE, q_of(i0 + n), q0, N, P3, scale, lane);
      Ks[n] = img + n * C::IMAGE + (C::QS ? C::PART : 0);
    }
    typename TL::S held;
    typename TL::P pn;
    float m0[NI], m1[NI], l0[NI], l1[NI];
    TL::row_max(held, m0, m1, qa, Ks, N, lane);
    TL::quad_max(m0, m1);
    TL::exps(pn, l0, l1, held, m0, m1, qa, Ks, N, lane);
    TL::quad_sum(l0, l1);
    // then the last tile's P V, and this tile waits in its place (or, not
    // deferring, runs its own now)
    if (dk >= 0) finish();
#pragma unroll
    for (int n = 0; n < NI; ++n) {
#pragma unroll
      for (int kk = 0; kk < TL::KG; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pd[n][kk][r] = pn[n][kk][r];
      dl0[n] = l0[n];
      dl1[n] = l1[n];
    }
    dk = k;
    if constexpr (!C::DEFER) finish();
  }
  if (dk >= 0) finish();
}

template <int DH, int NKT>
int launch(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
           cudaStream_t s) {
  using C = PairCore<DH, NKT>;
  static_assert(C::SMEM <= SMEM_MAX, "a pair slot passes the shared memory");
  auto kern = attn_pairs_kernel<DH, NKT>;
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
// 256 keys; one pair slot of K and V passes the shared memory at head_dim
// 128 past 208.
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

MFV_API int mfv_attn_pairs(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                           const void* bqkv, const void* wproj, const void* bproj, void* qkv,
                           void* o, void* out, int B, int N, int D, int heads, int cb, float scale,
                           void* stream) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || D % heads != 0 || cb <= 0 || cb % 2 != 0 ||
      B % cb != 0 || (long long)B / cb * heads > 0x7fffffffLL || !blk::ln1_takes(D))
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
