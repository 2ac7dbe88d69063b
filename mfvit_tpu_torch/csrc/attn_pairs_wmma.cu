// T1 attn_pairs, first design, kept as the check-only entry
// mfv_attn_pairs_wmma that the card's checks hold T1 (attn_pairs.cu, on
// K1's four launches) against: K1's function, x + proj(MHSA(LN(x))), with
// the harness's pair-batched schedule (tools/bench_attn_pairs.py::
// attn_pairs, Pallas _attn_pairs_kernel :37). The TPU kernel batches the
// score and PV dot_generals of two images into one (2H, dh, N) batch, so
// each matrix unit dispatch carries twice the independent products, and
// issues the softmax of pair i+1 before the PV of pair i.
//
// Four launches on one stream, as K1's former chain (fused_attn.cu's
// mfv_fused_attention_block_wmma, which gives K1's bits): the LN row
// statistics and the LN + qkv GEMM (gemm_ln.cuh), the pair core below, the
// proj GEMM with its bias and the bf16 residual (gemm_ln.cuh).
//
// The Hopper form of the (2H, dh, N) batch: a block owns one head of cb
// images (cb / 2 pairs) on a grid of (heads, B / cb), and a unit is that
// head of both images of a pair over 64 query rows. Eight warps work on a
// unit, four on each image, 16 rows each; both images' K and Vt of the
// head sit in shared memory. Each warp issues the scores and softmax of
// its next unit before the PV of its last one, across the pairs too: the
// last unit's P stays in registers as packed bf16 A fragments (half the
// registers of its fp32 scores). At a pair boundary the next pair's K
// replaces the last pair's (all of whose score products are done) before
// those scores, and its Vt replaces the last pair's after the last PV.
//
// Each warp runs attn_core.cuh's stages on its 16 query rows unchanged
// (q scaled in fp32 and rounded, fp32 scores and softmax, p rounded to
// bf16 for PV, 1/sum applied to the fp32 PV output), and the GEMMs are
// K1's, so T1 equals the K1 kernel bit for bit.
//
// What bounds it on an H100: K1's work, 75 GFLOP at ViT-S B=256 (0.076 ms
// at the bf16 peak). Two images' K and Vt take 2 x 30 KiB at head_dim 32
// and N = 197, and 2 x 109 KiB at head_dim 128, so head_dim 128 takes
// N <= 208. It ran 1.136 ms at ViT-S B=256, cb=4 (PERF.md).
#include "attn_core.cuh"
#include "gemm_ln.cuh"

namespace {

constexpr int QB = 64;                // query rows of a unit: 16 per warp
constexpr int IMG_THREADS = 128;      // four warps on each image of a pair
constexpr int PAIR_THREADS = 2 * IMG_THREADS;

template <int DH, int NKT>
__global__ void __launch_bounds__(PAIR_THREADS)
    attn_pairs_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int N, int heads,
                      float scale, int cb) {
  using S = AttnSmem<DH, NKT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, img = warp / 4, tid = threadIdx.x % IMG_THREADS;
  bf16* Ks = reinterpret_cast<bf16*>(smem + img * S::BYTES);  // this warp's image
  bf16* Vt = Ks + S::NK * S::LDK;
  const int h = blockIdx.x, D = heads * DH;
  const int qblocks = (N + QB - 1) / QB, units = cb / 2 * qblocks;
  auto image = [&](int u) { return blockIdx.y * cb + 2 * (u / qblocks) + img; };
  auto base = [&](int u) { return qkv + (size_t)image(u) * N * 3 * D + h * DH; };
  auto rows = [&](int u) { return (u % qblocks) * QB + (warp % 4) * 16; };

  attn_stage_kv<DH, NKT>(base(0), D, N, Ks, Vt, tid, IMG_THREADS);
  __syncthreads();

  float s[NKT][4], l0 = 0.f, l1 = 0.f;
  uint32_t pa[NKT / 2][4];  // the last unit's P, packed
  float pl0 = 0.f, pl1 = 0.f;
  for (int u = 0; u <= units; ++u) {
    const bool new_pair = u > 0 && u < units && u % qblocks == 0;
    if (new_pair) {  // this pair's K over the last pair's
      __syncthreads();
      attn_stage_k<DH, NKT>(base(u), D, N, Ks, tid, IMG_THREADS);
      __syncthreads();
    }
    const int q0 = rows(u);
    const bool has = u < units && q0 < N;
    if (has) {
      attn_scores<DH, NKT>(base(u), D, N, q0, scale, Ks, s);
      attn_softmax<NKT>(s, N, l0, l1);
    }
    if (u > 0 && rows(u - 1) < N)
      attn_pv_packed<DH, NKT>(pa, pl0, pl1, Vt, o + (size_t)image(u - 1) * N * D + h * DH, D, N,
                              rows(u - 1));
    if (new_pair) {  // this pair's Vt over the last pair's, after its last PV
      __syncthreads();
      attn_stage_vt<DH, NKT>(base(u), D, N, Vt, tid, IMG_THREADS);
      __syncthreads();
    }
    if (has) {
      attn_pack_p<NKT>(s, pa);
      pl0 = l0;
      pl1 = l1;
    }
  }
}

template <int DH, int NKT>
int launch_pairs(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                 cudaStream_t stream) {
  const int smem = 2 * (int)AttnSmem<DH, NKT>::BYTES;
  auto kern = attn_pairs_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(heads, B / cb), PAIR_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(o), N, heads, scale, cb);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as attn_core's.
template <int DH>
int launch_pairs_n(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                   cudaStream_t s) {
  if (N <= 64) return launch_pairs<DH, 8>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 128) return launch_pairs<DH, 16>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 208) return launch_pairs<DH, 26>(qkv, o, B, N, heads, scale, cb, s);
  if constexpr (DH < 128) return launch_pairs<DH, 32>(qkv, o, B, N, heads, scale, cb, s);
  return (int)cudaErrorInvalidValue;  // two images' K and Vt pass the shared memory
}

}  // namespace

MFV_API int mfv_attn_pairs_wmma(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                           const void* bqkv, const void* wproj, const void* bproj, void* stats,
                           void* qkv, void* o, void* out, int B, int N, int D, int heads, int cb,
                           float scale, void* stream) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || D % heads != 0 || cb <= 0 || cb % 2 != 0 ||
      B % cb != 0 || B / cb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, dh = D / heads;
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s, [&] {
    switch (dh) {
      case 32: return launch_pairs_n<32>(qkv, o, B, N, heads, scale, cb, s);
      case 64: return launch_pairs_n<64>(qkv, o, B, N, heads, scale, cb, s);
      case 128: return launch_pairs_n<128>(qkv, o, B, N, heads, scale, cb, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
