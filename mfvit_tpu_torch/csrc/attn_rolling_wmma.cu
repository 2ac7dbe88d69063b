// T2's former design, kept for the card's checks only (no tool runs it;
// attn_rolling.cu holds T2 as it runs now): K1's function, x +
// proj(MHSA(LN(x))), with the rolling schedule of tools/bench_rolling.py::
// attn_rolling (Pallas _attn_kernel_rolling :35), through the chain K1 ran
// before its redesign.
//
// Four launches on one stream, as K1's former chain (fused_attn.cu's
// mfv_fused_attention_block_wmma, which gives K1's bits): the LN row
// statistics and the LN + qkv GEMM (gemm_ln.cuh), the rolling core below,
// the proj GEMM with its bias and the bf16 residual (gemm_ln.cuh).
//
// The rolling core: a block of four warps owns one head of cb images on a
// grid of (heads, B / cb) and walks the images in order, 64 query rows (16
// per warp) a unit. Shared memory holds two images' K and Vt, image b in
// one buffer and b+1 in the other. Each warp issues the scores and softmax
// of its next unit before the PV of its last one, so at an image boundary
// image b+1's scores and softmax come before image b's last PV; the last
// unit's P waits in registers as packed bf16 A fragments. Image b+1's K
// rows are loaded by cp.async a whole image ahead, into the buffer whose
// image b-1 has no score left to compute; its Vt (a transpose, which
// cp.async cannot do) is staged at the boundary, after image b-1's last PV.
//
// Each warp runs attn_core.cuh's stages on its 16 query rows unchanged
// (q scaled in fp32 and rounded, fp32 scores and softmax, p rounded to
// bf16 for PV, 1/sum applied to the fp32 PV output), and the GEMMs are
// K1's, so it equals the K1 kernel, and T2, bit for bit. Two images' K and
// Vt take 2 x 30 KiB at head_dim 32 and N = 197, and 2 x 109 KiB at
// head_dim 128, so head_dim 128 takes N <= 208.
#include "attn_core.cuh"
#include "gemm_ln.cuh"

namespace {

constexpr int QB = 64;  // query rows of a unit: 16 per warp
constexpr int ROLL_THREADS = 128;

template <int DH, int NKT>
__global__ void __launch_bounds__(ROLL_THREADS)
    attn_rolling_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int N, int heads,
                        float scale, int cb) {
  using S = AttnSmem<DH, NKT>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = [&](int i) { return reinterpret_cast<bf16*>(smem + (i & 1) * S::BYTES); };
  auto Vt = [&](int i) { return Ks(i) + S::NK * S::LDK; };
  const int warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int h = blockIdx.x, D = heads * DH;
  const int qblocks = (N + QB - 1) / QB, units = cb * qblocks;
  auto image = [&](int i) { return (size_t)blockIdx.y * cb + i; };
  auto base = [&](int i) { return qkv + image(i) * N * 3 * D + h * DH; };
  auto rows = [&](int u) { return (u % qblocks) * QB + warp * 16; };

  attn_stage_kv<DH, NKT>(base(0), D, N, Ks(0), Vt(0), tid, ROLL_THREADS);
  if (cb > 1) attn_stage_k<DH, NKT, true>(base(1), D, N, Ks(1), tid, ROLL_THREADS);
  cp_async_commit();
  __syncthreads();

  float s[NKT][4], l0 = 0.f, l1 = 0.f;
  uint32_t pa[NKT / 2][4];  // the last unit's P, packed
  float pl0 = 0.f, pl1 = 0.f;
  for (int u = 0; u <= units; ++u) {
    const int i = u / qblocks;
    if (u > 0 && u < units && u % qblocks == 0) {
      // image i's Vt over image i-2's (whose PVs all ran by unit u-1), and
      // its K rows, in flight since image i-1 began, have landed
      __syncthreads();
      attn_stage_vt<DH, NKT>(base(i), D, N, Vt(i), tid, ROLL_THREADS);
      cp_async_wait<0>();
      __syncthreads();
      // image i+1's K rows over image i-1's, whose scores are all done
      if (i + 1 < cb) attn_stage_k<DH, NKT, true>(base(i + 1), D, N, Ks(i + 1), tid, ROLL_THREADS);
      cp_async_commit();
    }
    const int q0 = rows(u);
    const bool has = u < units && q0 < N;
    if (has) {
      attn_scores<DH, NKT>(base(i), D, N, q0, scale, Ks(i), s);
      attn_softmax<NKT>(s, N, l0, l1);
    }
    if (u > 0 && rows(u - 1) < N) {
      const int j = (u - 1) / qblocks;
      attn_pv_packed<DH, NKT>(pa, pl0, pl1, Vt(j), o + image(j) * N * D + h * DH, D, N,
                              rows(u - 1));
    }
    if (has) {
      attn_pack_p<NKT>(s, pa);
      pl0 = l0;
      pl1 = l1;
    }
  }
}

template <int DH, int NKT>
int launch_rolling(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                   cudaStream_t stream) {
  const int smem = 2 * (int)AttnSmem<DH, NKT>::BYTES;
  auto kern = attn_rolling_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(heads, B / cb), ROLL_THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(o), N, heads, scale, cb);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as attn_core's.
template <int DH>
int launch_rolling_n(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                     cudaStream_t s) {
  if (N <= 64) return launch_rolling<DH, 8>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 128) return launch_rolling<DH, 16>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 208) return launch_rolling<DH, 26>(qkv, o, B, N, heads, scale, cb, s);
  if constexpr (DH < 128) return launch_rolling<DH, 32>(qkv, o, B, N, heads, scale, cb, s);
  return (int)cudaErrorInvalidValue;  // two images' K and Vt pass the shared memory
}

}  // namespace

MFV_API int mfv_attn_rolling_wmma(const void* x, const void* ln_s, const void* ln_b,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  const void* bproj, void* stats, void* qkv, void* o, void* out,
                                  int B, int N, int D, int heads, int cb, float scale,
                                  void* stream) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || D % heads != 0 || cb <= 0 || B % cb != 0 ||
      B / cb > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, dh = D / heads;
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s, [&] {
    switch (dh) {
      case 32: return launch_rolling_n<32>(qkv, o, B, N, heads, scale, cb, s);
      case 64: return launch_rolling_n<64>(qkv, o, B, N, heads, scale, cb, s);
      case 128: return launch_rolling_n<128>(qkv, o, B, N, heads, scale, cb, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
