// T4 attn_staged, first design, kept as the check-only entry
// mfv_attn_staged_wmma that the card's checks hold T4 (attn_staged.cu, on
// K1's four launches) against: K1's function, x + proj(MHSA(LN(x))), with
// the harness's staged schedule (tools/bench_pipelined.py::attn_staged,
// Pallas _attn_kernel_staged :118). The TPU kernel computes every score product
// of its cb images first, then the softmax of image b+1 before the PV and
// proj products of image b, so the vector unit overlaps the matrix unit.
//
// Four launches on one stream, as K1's former chain (fused_attn.cu's
// mfv_fused_attention_block_wmma, which gives K1's bits): the LN row
// statistics and the LN + qkv GEMM (gemm_ln.cuh), the staged core below,
// the proj GEMM with its bias and the bf16 residual (gemm_ln.cuh). One
// image's qkv (443 KiB at ViT-S) does not fit a block's shared memory and
// a 197 x 197 fp32 score tile is 155 KiB, so the staging runs over units,
// not whole images: a unit is one query block (64 rows) of one image's
// head, and each of the block's two warpgroups owns every other head of
// the block's cb images, holding that head's K and V (V transposed) in
// its own shared memory.
//
// The Hopper form of the staging is ping-pong between the two warpgroups,
// ordered by two named barriers: a warpgroup waits (bar.sync) on its own
// before its tensor-core phase, which runs the PV product of its previous
// unit and the q k^T product of its next, and arrives (bar.arrive) on the
// other's after it; then it runs the exp and row sums of that next unit
// on the CUDA cores and SFUs while the other warpgroup's MMAs run. The
// scores stay in registers from their product through the softmax to PV.
//
// Each warp runs attn_core.cuh's stages on its 16 query rows unchanged
// (q scaled in fp32 and rounded, fp32 scores and softmax with keys walked
// as there, p rounded to bf16 for PV, 1/sum applied to the fp32 PV
// output), and the GEMMs are K1's, so T4 equals the K1 kernel bit for bit.
//
// What bounds it on an H100: K1's work, 75 GFLOP at ViT-S B=256 (0.076 ms
// at the bf16 peak); the core itself reads qkv once and writes o once.
// Two warpgroups' K and Vt take 2 x 30 KiB at head_dim 32 and N = 197, and
// 2 x 109 KiB at head_dim 128, so head_dim 128 takes N <= 208.
#include "attn_core.cuh"
#include "gemm_ln.cuh"

namespace {

constexpr int QB = 64;  // query rows of a unit: one 16-row tile per warp

template <int DH, int NKT>
__global__ void __launch_bounds__(2 * WG)
    attn_staged_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int N, int heads,
                       float scale, int cb) {
  using S = AttnSmem<DH, NKT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG, warp = tid >> 5;
  bf16* Ks = reinterpret_cast<bf16*>(smem + wg * S::BYTES);
  bf16* Vt = Ks + S::NK * S::LDK;
  const int D = heads * DH;

  // unit u of this warpgroup: head 2 * (u / qblocks) + wg of the block's
  // cb * heads (image, head) pairs, query block u % qblocks
  const int pairs = cb * heads, qblocks = (N + QB - 1) / QB;
  const int units = (pairs + 1) / 2 * qblocks;  // the same count for both
  auto pair_of = [&](int u) { return 2 * (u / qblocks) + wg; };
  auto head_base = [&](int pr) {  // the pair's q columns of its first token
    const int b = blockIdx.x * cb + pr / heads, h = pr % heads;
    return qkv + (size_t)b * N * 3 * D + h * DH;
  };
  auto o_base = [&](int pr) {
    const int b = blockIdx.x * cb + pr / heads, h = pr % heads;
    return o + (size_t)b * N * D + h * DH;
  };

  float s[NKT][4], l0 = 0.f, l1 = 0.f;
  if (wg == 1) pp_pass(PP_BAR);  // warpgroup 0 takes the tensor cores first
  // Each warpgroup runs units + 1 phases; a phase without work passes the
  // turn on, so every wait meets one arrival.
  for (int u = 0; u <= units; ++u) {
    pp_wait(PP_BAR + wg);
    if (u > 0) {  // PV of the previous unit
      const int pr = pair_of(u - 1), q0 = ((u - 1) % qblocks) * QB + warp * 16;
      if (pr < pairs && q0 < N) attn_pv<DH, NKT>(s, l0, l1, Vt, o_base(pr), D, N, q0);
    }
    const int pr = pair_of(u), q0 = (u % qblocks) * QB + warp * 16;
    const bool has = u < units && pr < pairs;
    if (has) {  // q k^T of this unit, after its head's K and V on a new head
      if (u % qblocks == 0) {
        group_sync(1 + wg);  // every warp is past the last head's PV
        attn_stage_kv<DH, NKT>(head_base(pr), D, N, Ks, Vt, tid, WG);
        group_sync(1 + wg);
      }
      if (q0 < N) attn_scores<DH, NKT>(head_base(pr), D, N, q0, scale, Ks, s);
    }
    if (wg == 0 || u < units) pp_pass(PP_BAR + 1 - wg);
    if (has && q0 < N) attn_softmax<NKT>(s, N, l0, l1);  // beside the other's MMAs
  }
}

template <int DH, int NKT>
int launch_staged(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                  cudaStream_t stream) {
  const int smem = 2 * (int)AttnSmem<DH, NKT>::BYTES;
  auto kern = attn_staged_kernel<DH, NKT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B / cb, 2 * WG, smem, stream>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(o), N,
                                         heads, scale, cb);
  return (int)cudaGetLastError();
}

// The smallest key-tile count that covers N, as attn_core's.
template <int DH>
int launch_staged_n(const void* qkv, void* o, int B, int N, int heads, float scale, int cb,
                    cudaStream_t s) {
  if (N <= 64) return launch_staged<DH, 8>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 128) return launch_staged<DH, 16>(qkv, o, B, N, heads, scale, cb, s);
  if (N <= 208) return launch_staged<DH, 26>(qkv, o, B, N, heads, scale, cb, s);
  if constexpr (DH < 128) return launch_staged<DH, 32>(qkv, o, B, N, heads, scale, cb, s);
  return (int)cudaErrorInvalidValue;  // two warpgroups' K and Vt pass the shared memory
}

}  // namespace

MFV_API int mfv_attn_staged_wmma(const void* x, const void* ln_s, const void* ln_b,
                                 const void* wqkv, const void* bqkv, const void* wproj,
                                 const void* bproj, void* stats, void* qkv, void* o, void* out,
                                 int B, int N, int D, int heads, int cb, float scale,
                                 void* stream) {
  if (B <= 0 || N <= 0 || N > NMAX || heads <= 0 || D % heads != 0 || cb <= 0 || B % cb != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, dh = D / heads;
  return attn_block(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, stats, qkv, o, out, M, D, s, [&] {
    switch (dh) {
      case 32: return launch_staged_n<32>(qkv, o, B, N, heads, scale, cb, s);
      case 64: return launch_staged_n<64>(qkv, o, B, N, heads, scale, cb, s);
      case 128: return launch_staged_n<128>(qkv, o, B, N, heads, scale, cb, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}
