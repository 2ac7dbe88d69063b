// T2 attn_rolling: K1's function, x + proj(MHSA(LN(x))), with the
// harness's rolling schedule, replacing tools/bench_rolling.py::
// attn_rolling (Pallas _attn_kernel_rolling :35). The TPU kernel computes
// the scores and softmax of image b+1 just before the PV of image b, so
// only two images' score buffers are live at once, which lets a grid step
// take cb = 8 or 16 images.
//
// K1's four launches on one stream (fused_attn.cu), through the caller's
// (M, 3D) bf16 qkv and (M, D) bf16 o scratch: block_tail.cuh's LN pass,
// the qkv GEMM with its bias on gemm_sm90.cuh's wgmma core, the rolling
// core below, and the proj GEMM with its bias and the bf16 residual on the
// same core.
//
// The rolling core is a sibling of K1's (attn_async.cu), in a unit of its
// own so that the two build in parallel and K1's stays as it is:
// - Persistent blocks, one an SM, walk units of one head of cb images (a
//   block's i-th image: unit bid + (i / cb) * grid, image i % cb of that
//   unit's group; adjacent blocks take adjacent heads of one group, so the
//   rows of qkv they read meet in L2), the images of each unit in order.
// - A producer warp stages each image's rows (zeros past N) by 16-byte
//   cp.async into a ring of two slots handed over by mbarriers, so image
//   b+1 arrives under image b's products: the two slots are the schedule's
//   two live images. A slot holds q, K and V where two such slots fit the
//   shared memory; else (head_dim 128, N up to 208: 2 x 169,728 bytes)
//   only K and V (2 x 113,152), and q's A fragments come from device
//   memory (16 rows a tile, read once; no third part to wait on).
// - Consumer warps take the flattened 16-row query tiles of the block's
//   images (warp w: tiles w, w + Wt, ...), and each issues the scores and
//   softmax of its next tile before the P V of its last one, whose P waits
//   in registers as packed bf16 A fragments (NKT / 2 x 4 registers, 52 at
//   N = 197). So at an image boundary image b+1's scores and softmax come
//   before image b's last P V. A slot is handed back when all its image's
//   tiles have run their P V (one arrival a tile).
// - The parity rule of K1's core, with the deferral: a warp that waits for
//   image i still holds its deferred tile's slot, and image i is staged
//   only after image i - 2 was handed back, so that tile must lie in image
//   i - 1 or i: at most T warps take tiles (Wt = min(W, T), T the tiles
//   of an image). The same bound keeps every wait one round from the last,
//   as parity alone tells rounds apart.
// - Fragments by ldmatrix from the row-major slots (V's by
//   ldmatrix.trans): no Vt copy and no block-wide barrier anywhere. The
//   per-tile pieces (the producer's copy of an image, q's fragments, the
//   scores, the masked max, exps and packing, the P V and its store) are
//   attn_tile.cuh's, which T1's pair core shares.
//
// Every score, maximum, exp, sum and P V runs in the order and with the
// rounding points of K1's core (attn_async.cu: the scores summed again for
// the exps, the same sums, or held between the two at head_dim 128), so
// T2 equals the K1 kernel bit for bit.
//
// What bounds it on an H100: K1's work, 74.8 GFLOP at ViT-S B=256 (0.076 ms
// at the bf16 peak); the core is bound as K1's is, by its CUDA-core work
// and the latency of each warp's chain, with fewer warps than K1's (T at
// most) and its image granularity: units = B / cb x heads over 132 SMs
// (192 at cb = 16 leave 60 SMs a second unit).
#include "attn_tile.cuh"
#include "block_tail.cuh"

namespace {

constexpr int SMEM_MAX = 232448;

template <int DH, int NKT>  // NKT: key tiles of 8 held (even), NKT * 8 >= N
struct RollCore {
  static constexpr int NK = NKT * 8;  // rows staged of each part
  static constexpr int LD = DH + 8;   // bf16 pitch of a staged row
  static constexpr int PART = NK * LD;
  // q beside K and V where two such slots fit
  static constexpr bool QS = 2 * 3 * PART * 2 + 4 * 8 <= SMEM_MAX;
  static constexpr int PARTS = QS ? 3 : 2;
  static constexpr int SLOT = PARTS * PART;  // bf16 of a slot
  static constexpr int SLOT_BYTES = SLOT * 2;
  static constexpr int SMEM = 2 * SLOT_BYTES + 4 * 8;
  // consumer warps and passes over the keys, as measured best on the card
  // (PERF.md): a thread holds the deferred P and the next tile's, NKT / 2
  // x 4 registers each; at head_dim 32 and 64 two passes (K1's: the scores
  // computed again, no row of them held) at 11 warps, 168 registers a
  // thread, beat 15 at 128 (spilling) and one pass at 7 and 11; at head_dim
  // 128, whose fragments and accumulators need 255 registers at 7 warps,
  // one pass (a row of fp32 scores held between the max and the exps)
  // beats two
  static constexpr int W = DH == 128 ? 7 : 11;
  static constexpr int PASSES = DH == 128 ? 1 : 2;
  static constexpr int THREADS = (W + 1) * 32;
};

template <int DH, int NKT>
__global__ void __launch_bounds__(RollCore<DH, NKT>::THREADS, 1)
    attn_rolling_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int B, int N,
                        int heads, float scale, int cb) {
  using C = RollCore<DH, NKT>;
  constexpr int W = C::W;
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

  if (warp == W) {  // the producer
    for (int i = 0; i < mine; ++i) {
      const int slot = i & 1;
      if (i >= 2) mbar_wait(&empty[slot], (i / 2 + 1) & 1);
      tile::stage_image<DH, NKT, C::PARTS>(ring + slot * C::SLOT, q_of(i) + (C::QS ? 0 : D), N,
                                           P3, D, lane);
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  using TL = tile::Tile<DH, NKT, 1, C::PASSES>;
  const int Wt = W < T ? W : T;
  const int g = lane >> 2, t4 = lane & 3;
  // the deferred tile: its P, packed, its row sums and where it lies
  typename TL::P pd;
  float dl0[1], dl1[1];
  int dk = -1;  // its index in the walk, -1 for none
  // P V of the deferred tile, 1/sum on the output (rounded once to bf16),
  // and its slot handed back
  auto finish = [&]() {
    const int i = dk / T, q0 = (dk - i * T) * 16, slot = i & 1;
    const bf16* Vs[1] = {ring + slot * C::SLOT + (C::PARTS - 1) * C::PART};
    typename TL::O oacc;
    TL::pv(oacc, pd, Vs, N, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // this tile is done with the slot
    TL::store(oacc[0], dl0[0], dl1[0], o + (image_of(i) * N + q0 + g) * D + head_of(i) + 2 * t4,
              q0, N, D, lane);
    dk = -1;
  };

  for (int k = warp; warp < Wt && k < mine * T; k += Wt) {
    const int i = k / T, q0 = (k - i * T) * 16, slot = i & 1;
    mbar_wait(&full[slot], (i / 2) & 1);
    const bf16* Ks[1] = {ring + slot * C::SLOT + (C::QS ? C::PART : 0)};
    // q's A fragments, rows q0 .. q0 + 15, scaled in fp32 and rounded; the
    // row max, then p = exp(s - max), the row sums and P packed
    typename TL::Q qa;
    tile::load_q<DH, C::QS>(qa[0], ring + slot * C::SLOT, q_of(i), q0, N, P3, scale, lane);
    typename TL::S held;
    typename TL::P pn;
    float m0[1], m1[1], l0[1], l1[1];
    TL::row_max(held, m0, m1, qa, Ks, N, lane);
    TL::quad_max(m0, m1);
    TL::exps(pn, l0, l1, held, m0, m1, qa, Ks, N, lane);
    TL::quad_sum(l0, l1);
    // then the last tile's P V, and this tile waits in its place
    if (dk >= 0) finish();
#pragma unroll
    for (int kk = 0; kk < TL::KG; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pd[0][kk][r] = pn[0][kk][r];
    dl0[0] = l0[0];
    dl1[0] = l1[0];
    dk = k;
  }
  if (dk >= 0) finish();
}

template <int DH, int NKT>
int launch(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
           cudaStream_t s) {
  using C = RollCore<DH, NKT>;
  auto kern = attn_rolling_kernel<DH, NKT>;
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

MFV_API int mfv_attn_rolling(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
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
